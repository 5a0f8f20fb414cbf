"""Core domain model: labels, identities, flows, engine configuration."""
