"""The harness: the cell's spec, its inputs, the drive of the program,
the correctness check, the trace and the yardstick."""
