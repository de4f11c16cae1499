"""Parallelism over processes: the data axis (``sharding.py``)."""
