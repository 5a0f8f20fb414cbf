"""Hubble-side consumers of served verdicts."""
