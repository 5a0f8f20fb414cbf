"""Synthetic scenario generators."""
