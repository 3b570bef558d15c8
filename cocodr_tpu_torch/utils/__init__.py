"""Small utilities."""
