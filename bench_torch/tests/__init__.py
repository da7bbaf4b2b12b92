"""CPU tests of the benchmark harness at tiny sizes."""
