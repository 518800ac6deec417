"""Decoded-media containers of the port (no container decode here)."""
