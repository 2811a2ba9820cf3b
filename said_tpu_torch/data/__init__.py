"""Dataset discovery for the port (host-side numpy, no pandas)."""
