"""Registration networks and their checkpoint loader."""
