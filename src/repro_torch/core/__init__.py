"""The MoR core: predictor, calibration, clustering, tile policy,
execution plans and the offline deployment stage."""
