"""Device operators: the polyphase FIR cascade and its CUDA kernel."""
