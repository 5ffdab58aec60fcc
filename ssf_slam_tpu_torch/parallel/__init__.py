"""Many sequences on one card (``mesh.py``) and its measurement
(``batch_economics.py``)."""
