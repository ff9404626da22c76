"""The benchmark's harness: inputs from the seed, the window, the device
trace, the work counts and peaks, the check against the plain reference."""
