"""CPU tests of the benchmark (and one that runs it on a card, marked `cuda`)."""
