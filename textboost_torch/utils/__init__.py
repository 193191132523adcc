"""Host-side utilities (trackers, step timer)."""
