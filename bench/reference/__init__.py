"""The plain reference the benchmark's check holds the program to."""
