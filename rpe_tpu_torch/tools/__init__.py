"""Offline tools: chessboard camera calibration (`calibrate`)."""
