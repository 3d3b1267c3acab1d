"""VO front end: state containers, keyframe tracking and the step."""
