"""The plain reference the timed path's outputs are held against: plain
torch and numpy, importing neither the JAX package nor the port."""
