"""CPU tests of the benchmark; the card's tests are marked ``gpu`` and skip without one."""
