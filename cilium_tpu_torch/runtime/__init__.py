"""Runtime pieces the port's engine reports through."""
