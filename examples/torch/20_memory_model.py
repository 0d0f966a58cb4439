"""Memory model: what replaced the reference's memory pools.

The reference (examples/20_memory_pools.cu, readme.md:135-200) exposes
MemoryPool handles because CUDA needs explicit caching allocators, per-thread
pools, and per-device pools.  In this build PyTorch's CUDA caching allocator
owns device memory:

  * allocations come from the allocator's per-device pools of cached
    blocks: there is no pool object to create per thread, and a freed
    tensor's block is reused by the next allocation of its size;
  * "one pool per device" becomes a tensor's device (torch.device, .to()):
    a tensor's placement selects its pool;
  * temporary buffers of an operation are allocated and freed on the
    current stream (the analog of the reference's Buffer /
    polynomial_buffer.h), and torch.cuda.empty_cache returns cached blocks.

This example demonstrates explicit placement and the allocator's counters.
"""

from common import DEVICE
import torch

dev = torch.device(DEVICE)
print("device:", dev, torch.cuda.get_device_name(dev) if dev.type == "cuda" else "")
x = torch.arange(8, dtype=torch.int64)
print("default placement:", x.device)
y = x.to(dev)
print("explicit placement:", y.device)
if dev.type == "cuda":
    before = torch.cuda.memory_allocated(dev)
    z = torch.empty(1 << 20, dtype=torch.int64, device=dev)
    grown = torch.cuda.memory_allocated(dev) - before
    del z
    reserved = torch.cuda.memory_reserved(dev)
    print(f"allocated {grown} bytes for 2^20 int64 words; after del, "
          f"{torch.cuda.memory_allocated(dev) - before} allocated and "
          f"{reserved} bytes still reserved in the cache")
    assert grown >= 8 << 20 and reserved >= grown
    print("memory stats:", {k: v for k, v in torch.cuda.memory_stats(dev).items()
                            if k.startswith("allocated_bytes.all.")})
else:
    print("memory stats: n/a (the CPU has no caching allocator)")
print("memory model OK")
