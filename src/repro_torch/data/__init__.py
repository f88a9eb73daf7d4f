"""Datasets made from a seed (no download)."""
