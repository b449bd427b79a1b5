"""The three-term roofline of the census's cells on the H100 (counterpart
of ``repro/roofline``)."""
