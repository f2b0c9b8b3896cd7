"""Statement makers: seeded inputs for each kind of statement, the benchmark's own."""
