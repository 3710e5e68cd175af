"""Engine counters and timing spans."""
