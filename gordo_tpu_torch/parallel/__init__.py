"""Fleet helpers."""
