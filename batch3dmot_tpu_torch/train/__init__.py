"""Window graph padding."""
