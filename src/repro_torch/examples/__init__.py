"""The reference's four examples on the port, each a module:
``python -m repro_torch.examples.<name>`` (quickstart, multiplex_rlvr,
train_100m, cluster_sim). They run on the CUDA card unless ``--device
cpu`` is given; cluster_sim needs no device."""
