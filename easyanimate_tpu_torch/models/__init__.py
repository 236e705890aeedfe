"""MMDiT transformer, embeddings, weight loading, the VAE and the text
tower."""
