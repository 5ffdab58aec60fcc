"""ssf_slam_tpu_torch — the PyTorch + CUDA port of ``ssf_slam_tpu`` for one
NVIDIA H100.

The JAX package beside it is the reference; this package imports nothing of
it and keeps its own copies of what it needs. The layout mirrors the JAX
package so that each module's counterpart is easy to find:

- ``ops``       geometry + neighbour engine (Morton codes, band plan, the
                banded and attention CUDA kernels with their plain PyTorch
                versions and gradients, kNN, FPS, grouping, SE(3), Kabsch)
- ``models``    TFlow scene-flow network (tower / head split), its loss and
                metrics
- ``odometry``  ego-motion from scene flow (static-masked IRLS Kabsch)
- ``frontend``, ``mapping``  plane features, keyframe map, pose graph
- ``engine``    the fused SSF step and its sequence runner
- ``train``     the train step, optimizer, loop, harness and entry point
- ``data``      the synthetic CARLA-style generator, label weights
- ``weights``   Flax <-> PyTorch parameter conversion, committed weights

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; they raise when CUDA is asked for and absent.
"""

__version__ = "0.1.0"
