"""The benchmark's own code: what later changes to the program cannot
move (traffic, counting, traces, comparisons, the runners of each kind of
traffic)."""
