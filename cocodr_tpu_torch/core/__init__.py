"""Typed configuration of the port's stages."""
