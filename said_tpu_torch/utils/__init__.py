"""Host-side helpers of the port (numpy and scipy only)."""
