"""Route handlers."""
