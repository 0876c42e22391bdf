"""Tests of the benchmark: its reference against the port on the CPU, its
harness, its yardsticks, its controls and faults."""
