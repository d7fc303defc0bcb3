"""The drivers of the traffic kinds a mix names (``"kind"``)."""
