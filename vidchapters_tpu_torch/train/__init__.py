"""Generation entry points (training is not ported yet)."""
