"""tpu_renderer — a software rasterizer in JAX (XLA + Pallas kernels).

A ground-up re-design of the capabilities of the reference Vulkan 1.3 forward
renderer (vkguide-style: dynamic rendering + sync2, glTF scene graph, compute
backgrounds, metallic-roughness forward pass) on an accelerator (an NVIDIA
GPU; the test suite runs on the CPU):

* the Vulkan device/swapchain/descriptor/pipeline machinery collapses into a
  single jit-compiled frame function (`tpu_renderer.pipeline`),
* the SPIR-V shader stages become Pallas kernels + fused XLA ops
  (`tpu_renderer.kernels`),
* the fastgltf loader + scene graph are host-side Python producing packed
  device arrays (`tpu_renderer.gltf`, `tpu_renderer.scene`),
* multi-chip scale-out shards the framebuffer/triangle work over a
  `jax.sharding.Mesh` (`tpu_renderer.parallel`).

Reference behavior citations use `file:line` paths into the reference tree
(e.g. ``vk_engine.cpp:1479``) so parity can be checked.
"""

from tpu_renderer.config import RendererConfig
from tpu_renderer.engine import Engine, EngineStats

__version__ = "0.1.0"

__all__ = ["RendererConfig", "Engine", "EngineStats", "__version__"]
