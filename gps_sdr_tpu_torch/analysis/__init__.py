"""Analysis & visualization: acquisition/tracking/PVT plots, multipath ACF
features, multipath simulator (reference: Plot_task_1..5.m, TrackingPlot*.m,
ACF/CalculateFeatures.m, acqtckpos/MultipathSimulator.m)."""
