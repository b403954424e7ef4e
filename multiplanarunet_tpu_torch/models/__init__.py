"""Inference models: the 2D U-Net, the fusion model, weight loading."""
