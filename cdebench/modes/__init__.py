"""The cells' modes, one file each (``<mode>.py``), found by the traffic's
``mode``: each holds a ``Session`` with ``setup``, ``call``, ``end_to_end``,
``failed``, ``work_counts``, ``free`` and ``readings``."""
