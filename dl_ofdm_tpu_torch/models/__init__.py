"""Receivers (the DCCN)."""
