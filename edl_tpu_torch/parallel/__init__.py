"""Meshes of the port (one device in this slice)."""
