"""Cost analysis of the port's programs: an op-level FLOP / byte / live
memory counter (``op_cost``), the collectives a grid issues
(``collectives``) and the three-term roofline of one H100 (``roofline``)."""
