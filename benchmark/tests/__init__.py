"""CPU tests of the benchmark (``python -m pytest benchmark/tests``); the card-marked ones run on the chip."""
