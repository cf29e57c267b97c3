"""Detection metrics (numpy only)."""
