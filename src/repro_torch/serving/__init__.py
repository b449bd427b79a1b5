"""Serving backends of the port: registered functions are torch models."""
