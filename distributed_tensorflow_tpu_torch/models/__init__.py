"""Models (forward only in this slice): :mod:`transformer`."""
