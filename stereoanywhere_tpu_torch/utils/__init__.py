"""Host-side helpers of the entry points: logging, visualisation and
profiling."""
