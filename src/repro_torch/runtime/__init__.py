"""Host-side serving runtime of the port (the slot scheduler)."""
