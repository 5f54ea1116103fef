"""Environment knobs and fault injection."""
