"""Search dispatch across devices (single device so far)."""
