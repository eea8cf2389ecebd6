"""Window runtime: sampler, decode loop, entry points."""
