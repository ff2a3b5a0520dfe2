"""Multi-rank execution: the ``('data', 'spatial')`` mesh (``mesh.py``)
and the row halos of a spatially sharded forward (``halo.py``)."""
