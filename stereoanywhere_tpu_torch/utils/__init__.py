"""Host-side helpers of the entry points."""
