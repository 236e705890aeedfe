"""Host-side helpers (numpy; PIL only where an image must be resized)."""
