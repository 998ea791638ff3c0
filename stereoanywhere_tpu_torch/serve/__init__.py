"""Serving: the end-to-end pipeline and its HTTP front end."""
