"""A small EuRoC-like camera and budgets for CPU runs of the cells:
the default configuration's distortion and focal ratios at 188x120."""

SMALL = dict(ImageWidth=188, ImageHeight=120, ZfX=114.66, ZfY=114.32,
             PPx=91.8, PPy=62.1, KeylineMax=2048, MaxPoints=2048,
             ReferencePoints=800, TrackPoints=2048, GlobalMatchThreshold=100,
             DetectorThresh=0.03, DetectorAutoGain=1e-6, InitBiasFrameNum=4)

