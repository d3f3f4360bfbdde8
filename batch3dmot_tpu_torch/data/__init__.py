"""Detection containers and synthetic scenes."""
