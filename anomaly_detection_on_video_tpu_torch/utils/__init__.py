"""Device resolution and weight conversion."""
