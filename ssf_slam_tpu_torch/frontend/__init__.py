"""Planar feature extraction (scan preprocessing)."""
