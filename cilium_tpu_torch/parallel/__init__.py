"""Host identity for the serving fleet (the reference's
``parallel/multihost.py``, its ``host_id`` alone)."""
