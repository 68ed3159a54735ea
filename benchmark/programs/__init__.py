"""The system under test, one file per configuration: how the port's own
entry points are built from the configuration's file, given the benchmark's
weights, and called as the port's runners call them. Nothing here computes
what the program computes."""
