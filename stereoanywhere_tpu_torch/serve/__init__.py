"""Serving: the end-to-end pipeline and its HTTP front end (`pipeline`), the
HTTP client (`client`) and the live capture loop (`camera`)."""
