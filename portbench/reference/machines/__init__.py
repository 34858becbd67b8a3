"""Machine kinds of the reference, one file each (``<kind>.py``:
``make(machine) -> (D, n)``)."""
