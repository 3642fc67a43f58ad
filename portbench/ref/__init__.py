"""The benchmark's plain NumPy reference: the flow generator, the windows
and their features, the subtree trainer, the partitioned walk and the
work count.  It imports nothing of the program it judges."""
