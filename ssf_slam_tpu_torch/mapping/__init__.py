"""Keyframe pose-graph mapping back end."""
