"""Serving helpers the streaming plane uses: the row ladder and the
per-member circuit breakers."""
