"""Policy engine: rule API, repository, selector cache, MapState."""
