"""Ego-motion from scene flow and the plane models of the back end."""
