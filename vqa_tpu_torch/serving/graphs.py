"""The serving forward as one CUDA graph per batch bucket and replica.

Counterpart of the JAX engine's "ONE compiled XLA program per batch
bucket" (``vqa_tpu/serving/engine.py:9-10``, the jitted ``forward`` at
``:168-174``): where JAX replays one compiled program per bucket, the port
replays one ``torch.cuda.CUDAGraph``. Each graph holds normalize → forward
→ softmax for one bucket's rows on one replica's device, reading static
input buffers (uint8 pixels, token ids, mask) and writing a static
probability buffer.

``VQAInference.load`` captures them with ``capture_replica``: for each
bucket, largest first, ``WARM_FORWARDS`` eager forwards on a side stream,
then the capture into the replica's one memory pool, which its bucket
graphs share. The caller runs copy in → replay → copy out of one replica's
graphs under one lock (``BucketGraph.run``). The capture, the replay and
the launch-count bookkeeping are ``vqa_tpu_torch.utils.graphs``'s, shared
with the trainer and the evaluator.
"""

from vqa_tpu_torch.utils.graphs import (  # noqa: F401
    WARM_FORWARDS,
    BucketGraph,
    capture_bucket,
    capture_replica,
)
