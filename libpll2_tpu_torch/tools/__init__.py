"""Tools of the port that run on the card (the counterparts of the
repository's tools/ scripts)."""
