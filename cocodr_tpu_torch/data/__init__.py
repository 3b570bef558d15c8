"""Token records and the batch prefetch thread (host side)."""
