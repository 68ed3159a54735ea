"""Copies of the program's sound measurement pieces, frozen so that a later
change to the program cannot move the yardstick. Each file names its origin."""
