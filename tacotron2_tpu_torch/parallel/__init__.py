"""Scale-out over torch.distributed (counterpart of `tacotron2_tpu/parallel/`): process
start-up, the (data, model) grid of ranks, the collectives of the data- and
tensor-parallel steps, and the WaveNet's tensor-parallel sharding."""
