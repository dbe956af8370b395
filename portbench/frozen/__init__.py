"""Frozen copies of the generators and arithmetic the benchmark's yardstick
rests on, so that no change to the program can move them."""
