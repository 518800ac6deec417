"""Analyzers of the port: video (heuristic path), heuristics, fusion."""
