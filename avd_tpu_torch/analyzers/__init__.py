"""Analyzers of the port: audio, video, fusion, heuristics, meta and forensic."""
