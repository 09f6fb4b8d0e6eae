"""Per-cell drivers, one file per traffic kind (``traffic/<mix>.json``'s ``kind``)."""
