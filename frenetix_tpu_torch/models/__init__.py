"""Wale-Net prediction: the ONNX reader (`onnx_lite`), its PyTorch
interpreter (`onnx_torch`) and the predictor (`walenet`)."""
