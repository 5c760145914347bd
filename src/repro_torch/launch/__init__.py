"""Serving step factories and the serving CLI of the port."""
