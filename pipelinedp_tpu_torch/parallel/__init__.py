"""Partition-axis parallelism of the port: the blocked large-P route
(large_p.py) for one device."""
