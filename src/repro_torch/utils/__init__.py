"""Device resolution and numpy -> port conversions."""
