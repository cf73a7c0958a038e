from multimodal_seq2seq_gscan_tpu_torch.parallel.mesh import (
    Mesh, make_mesh, replicate, shard_batch)
