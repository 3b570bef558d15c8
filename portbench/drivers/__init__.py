"""One module per kind of window; each has run(ctx) -> harness.Outcome."""
