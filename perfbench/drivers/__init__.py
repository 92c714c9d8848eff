"""The general generators that traffic mixes name (``"driver"``): each sets up
a cell's program from the seed, runs its measured window, its traced window
and its check, and returns the run's record."""
