"""Grid GMM, MuPS statistics (plain + CUDA kernel) and NN blocks."""
