"""The demos of the port: ``demo`` (videos through ``inference_vis`` into
mp4 files), ``clip_demo`` (images as pseudo-clips through
``inference_image``) and ``visualizer_from_json`` (a results file drawn on
its frames), with ``predictor.AsyncPredictor`` and
``visualizer.TrackVisualizer``."""
