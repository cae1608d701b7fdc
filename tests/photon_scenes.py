"""Scene text the photon tests share. It imports nothing, so that the
card's tests (which run without JAX) can use it too.

PHOTON_SCENE: a spot, a distant, a point, a triangle area and a sphere
area light; a homogeneous medium and a rainbow region; a dispersive
glass sphere over a matte floor and wall.
"""

PHOTON_SCENE = """Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "lowdiscrepancy" "integer pixelsamples" [1]
LookAt 0 1.2 -5  0 0.3 0  0 1 0
Camera "perspective" "float fov" [40]
SurfaceIntegrator "photonmap" "integer nused" [40] "float maxdist" [0.4]
  "integer causticphotons" [3000] "integer indirectphotons" [3000]
  "bool finalgather" ["true"] "integer finalgathersamples" [4]
VolumeIntegrator "photonvolume" "float stepsize" [0.5] "integer nused" [30]
  "float maxdist" [0.6] "integer volumephotons" [3000]
WorldBegin
LightSource "spot" "point from" [0.4 3.5 0] "point to" [0.4 0 0] "float coneangle" [20]
  "float conedeltaangle" [4] "rgb I" [80 80 80]
LightSource "distant" "point from" [2 3 -2] "point to" [0 0 0] "rgb L" [1.5 1.5 1.5]
LightSource "point" "point from" [-1.5 2 -1] "rgb I" [6 6 6]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [4 4 4]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-2.5 2.8 -0.5  -1.5 2.8 -0.5  -1.5 2.8 0.5  -2.5 2.8 0.5]
AttributeEnd
AttributeBegin
  Translate 1.8 1.5 -0.5
  AreaLightSource "diffuse" "rgb L" [3 3 3]
  Shape "sphere" "float radius" [0.15]
AttributeEnd
Volume "homogeneous" "point p0" [-3 -0.6 -3] "point p1" [3 3 3]
  "rgb sigma_a" [.05 .05 .05] "rgb sigma_s" [.25 .25 .25] "float g" [0.2]
Volume "rainbow" "point p0" [-3 1.8 -3] "point p1" [0 3 3]
  "rgb sigma_a" [.02 .02 .02] "rgb sigma_s" [.1 .1 .1]
AttributeBegin
  Material "glass" "float index" [1.5] "float Vn" [40]
  Translate 0.4 0.4 0
  Shape "sphere" "float radius" [0.6]
AttributeEnd
Material "matte" "rgb Kd" [.6 .6 .6]
Shape "trianglemesh" "integer indices" [0 2 1 0 3 2]
  "point P" [-4 -0.5 -4  4 -0.5 -4  4 -0.5 4  -4 -0.5 4]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-4 -0.5 2  4 -0.5 2  4 3 2  -4 3 2]
WorldEnd
"""
