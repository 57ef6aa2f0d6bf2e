"""Parallel serving on ``torch.distributed`` (counterpart of
``p2vit_tpu/parallel/``): ``dist`` (rank groups, host-staged collectives),
``mesh`` (the ("data", "model") grid, DP, sharded statistics), ``tensor``
(megatron TP/SP for ViT), ``tensor_swin`` (TP for Swin), ``pipeline``
(GPipe PP) and ``dryrun`` (every path on tiny shapes). The submodules are
imported where they are used."""
