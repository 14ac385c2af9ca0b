"""Host-side helpers: devices, padding, crash points."""
