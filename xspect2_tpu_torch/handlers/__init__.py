"""Clients for external data sources (imported lazily: they need ``requests``)."""
