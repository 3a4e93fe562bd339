"""Serving: chat templates, the continuous-batching engine and the HTTP server."""
