"""Drivers: one per entry point of the port that traffic mixes drive. A mix
file names its driver (`"driver"`), which reads the mix's parameters, runs
the closed loop over the window and compares what the timed path produced
with the plain reference."""
