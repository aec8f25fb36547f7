"""Layer modules."""
