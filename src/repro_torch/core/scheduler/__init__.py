"""Cluster scheduler: cyclic horizon, hierarchical resource view, placement
(Eq. 1-2), HRRS runtime ordering (Alg. 1) with an incremental
kinetic-tournament admission index, task-executor FSM."""
