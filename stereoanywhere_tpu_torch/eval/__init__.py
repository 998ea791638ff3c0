"""The zero-shot evaluation path: the benchmark protocol (`harness`), its
metrics and reports, and the card programs it runs (`programs`)."""
